"""One reader a per-layer metric: ``<metric>.py`` defines ``read(summary,
cell)``, which takes the metric from the traced slice
(:class:`portbench.trace.Summary`) and returns a number, or None when the
slice holds nothing it reads (the runner then leaves the metric out)."""
