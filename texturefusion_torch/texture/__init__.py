"""texturefusion_torch.texture."""
