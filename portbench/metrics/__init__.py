"""One reader per metric, named as the metric: ``read(ctx)`` -> a number, or None where it finds nothing."""
