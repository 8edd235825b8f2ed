"""Model layers, GQA attention, the decoder stack and the LM."""
