"""LeNet and its layers over a leading device axis."""
