"""Measurement and dataset tools of the PyTorch/CUDA port (each runs as
``python -m audio_mps_tpu_torch.tools.<name>``)."""
