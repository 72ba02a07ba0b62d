"""One module per metric, named as the metric, each with ``read(ctx)``;
modules whose names start with ``_`` hold the counts the readers share."""
