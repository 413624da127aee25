"""Models as ``nn.Module``s."""
