"""Training: detection loss, augmentation, dataset and the trainer."""
