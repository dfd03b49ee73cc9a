"""Plain PyTorch references of the benchmark's configurations: the same
models on the same data, written without the program."""
