"""Per-layer metric readers: ``portbench/readers/<reader>.py`` defines
``read(ctx, spec)``, which returns the metric's value from the traced
window, or None where the trace holds nothing for it to read.  A metric's
file under ``portbench/metrics/`` names its reader."""
