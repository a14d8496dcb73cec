"""The benchmark's own counts of the work that the inputs need, and the
H100's peaks. Frozen: they count what the algorithm needs, the same
whatever form or kernel computes it, so that a later PR cannot move the
yardstick by changing the program."""
