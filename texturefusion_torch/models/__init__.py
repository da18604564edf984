"""texturefusion_torch.models."""
