"""One module per kind of traffic mix: its set-up, one unit of work on the
program, and the comparison of the window's outputs with the reference."""
