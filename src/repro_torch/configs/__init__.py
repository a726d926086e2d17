"""Architecture configs: each exports ``CONFIG`` (the published widths)
and ``reduced()`` (a small same-family config for CPU tests)."""
