"""texturefusion_torch.core."""
