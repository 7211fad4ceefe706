"""Host utilities: box math, union-find, synthetic mosaics, device selection."""
