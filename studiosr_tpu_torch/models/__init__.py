"""Models of the port (NHWC, PyTorch)."""
