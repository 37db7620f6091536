"""Segment Anything: the ViT encoder, prompt encoder and mask decoder, and
the predictor with its selection on the device."""
