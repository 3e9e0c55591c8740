"""The all-pairs MI engine (solver), threshold tournament, outlier fences
and ARACNE wrapper of the port."""
