"""texturefusion_torch.utils."""
