"""Model configuration and the decoder-only LM (the port of ``repro.models``)."""
