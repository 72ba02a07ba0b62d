"""One module per model family; a configuration names its driver."""
