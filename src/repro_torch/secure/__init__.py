from repro_torch.secure.secure_linear import SecureLinear, SecureMatmulEngine

__all__ = ["SecureLinear", "SecureMatmulEngine"]
