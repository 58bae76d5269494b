"""Plain float32 references: importing nothing of the program, they work out
the predictor, the slot choice, the translation, the capacity drops and the
forward again from the benchmark's own inputs and weights."""
