"""texturefusion_torch.fusion."""
