"""Command-line tools of the port (``python -m
paddle_tpu_torch.tools.<name>``): ``serve_fleet``, the serving fleet's
worker and door."""
