"""The harness: cells, runs, traces and the check of what a run served."""
