from spydrpick_torch.cli import main

raise SystemExit(main())
