"""Data layer: plate-reader CSV parsing and the array dataset pipeline."""
