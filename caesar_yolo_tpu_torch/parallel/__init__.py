"""The batched tile-detection engine on one GPU."""
