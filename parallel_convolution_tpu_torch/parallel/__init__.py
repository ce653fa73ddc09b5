"""Block grid, halo exchange, kernel-form registry and iteration driver."""
