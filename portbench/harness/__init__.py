"""The benchmark's generic part: finding a cell's files, running its loop,
reading the trace, and building the result line."""
