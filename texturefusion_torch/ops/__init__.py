"""texturefusion_torch.ops."""
