"""Detection: letterbox, fixed-shape NMS with its suppression kernel, predictor, merge, analyzer."""
