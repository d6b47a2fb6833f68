"""Device compute path: JAX decode/encode programs and the Triton kernel."""
