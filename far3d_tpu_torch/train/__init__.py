"""Training: denoising queries, matching, losses, optimizer and the step."""
