"""Training augmentations that insert unnatural bases: spike (synthetic
signal) and stitch (real XNA signal slices), as batched torch on the
training device."""
