"""The reference's ``bayesian_torch.ao.nn.quantized`` namespace."""
