"""The benchmark's own library: what `bench/run.py` needs besides the
program under test. Nothing here imports the program at module level."""
