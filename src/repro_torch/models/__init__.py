"""The transformer substrate of the port: decoders of attention blocks,
dense or with sparse experts, GQA or latent attention, of RG-LRU
recurrent blocks and of xLSTM blocks (common pieces, attention, experts,
the RG-LRU, the mLSTM and sLSTM, composition, decoding)."""
