"""texturefusion_torch.io."""
