"""The harness: finds a cell's files by name, makes its inputs, drives the
program, reads the trace, checks the outputs."""
