"""Model code of the serving path: layers and the dense decoder."""
