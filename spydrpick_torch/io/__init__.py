"""Host I/O of the port: FASTA reader/writer, loci and value lists, output
writers (copies of ``spydrpick_tpu.io``)."""
