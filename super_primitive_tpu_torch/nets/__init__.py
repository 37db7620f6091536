"""The port's networks: SAM (encoder, prompt encoder, decoder, predictor)
and the EfficientNet-B5 normal net NNET."""
