"""The transformer substrate of the port: dense GQA decoders (common
pieces, attention, composition, decoding)."""
