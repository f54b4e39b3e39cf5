"""Measurement tools of the PyTorch port (``python -m krisp_tpu_torch.tools.<name>``)."""
