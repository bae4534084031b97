"""The benchmark's frozen work counts: the operations and bytes that one
control step (K1) and one view's frames (K2 at lo, K4 at hi) of a state
need, and the least time one H100 could take for them.  The counts read
their geometry only from the frozen reference (``portbench/reference``),
so that no change to the port's kernels or helpers moves them."""
