"""Dense decoder model: config, layers, attention, blocks, top-level LM."""
