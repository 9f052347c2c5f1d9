"""layers of the PyTorch port (see mspl_tpu_torch/__init__.py)."""
