"""The transformer substrate of the port: decoders of attention blocks,
dense or with sparse experts, GQA or latent attention (common pieces,
attention, experts, composition, decoding)."""
