"""Plain PyTorch references, one module per model family.  They import
nothing of the program under test."""
