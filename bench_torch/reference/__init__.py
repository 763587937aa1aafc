"""Plain PyTorch references of the benchmark's model families (f32, no
kernel, nothing of the program imported)."""
