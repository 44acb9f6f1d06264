"""Hand-written Pallas kernels for NVIDIA GPUs (Triton route).

Each kernel has an XLA path beside it; utils/platform.route chooses between
them. A kernel stays only while it beats that XLA path on the card."""
