"""CPU tests of the benchmark (run: `PYTHONPATH=src python -m pytest perfbench/tests`);
the `gpu` ones run on the card and skip here."""
