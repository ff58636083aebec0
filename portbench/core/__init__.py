"""The harness: finds a cell's files by name, runs its closed loop, reads
the trace and prints the result line."""
