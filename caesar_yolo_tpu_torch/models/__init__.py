"""YOLOv8 / YOLO11 as nn.Modules, the C2PSA attention kernel, npz weight loading."""
