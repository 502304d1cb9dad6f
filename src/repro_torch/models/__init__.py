"""The transformer substrate of the port: decoders of attention blocks,
dense or with sparse experts, GQA or latent attention, and of RG-LRU
recurrent blocks (common pieces, attention, experts, the RG-LRU,
composition, decoding)."""
