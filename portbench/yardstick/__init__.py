"""The yardstick: peaks, counted work, frozen traffic generators and test
images.  Frozen with the benchmark, so a change to the program cannot move
it."""
