"""Plain PyTorch references of the configurations. They import nothing of
the program and take nothing it made: the benchmark hands them its own
weights and inputs, and they work out the memory's state themselves."""
