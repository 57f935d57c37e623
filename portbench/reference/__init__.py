"""Plain references of the ticks the benchmark's cells serve: plain PyTorch
and NumPy, written from the method, importing nothing of the program under
test."""
