"""ViT configuration and building blocks (PyTorch)."""
