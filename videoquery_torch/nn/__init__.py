"""BN-Inception and the two-stream TSN ensemble in PyTorch."""
