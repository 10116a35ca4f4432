"""DDPM schedule math and the SiD one-step sampler, in PyTorch."""
