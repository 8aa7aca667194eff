"""Model families: parameter layout, initial draw, FLOPs, plain reference."""
