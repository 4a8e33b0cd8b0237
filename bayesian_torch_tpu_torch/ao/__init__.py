"""The reference's ``bayesian_torch.ao`` namespace (quantization API)."""
