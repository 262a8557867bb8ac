"""Training on one device: AdamW and the train step, the loop."""
