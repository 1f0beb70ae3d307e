"""Plain PyTorch references of the configurations, and AdamW."""
