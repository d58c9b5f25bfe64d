"""Model layers of the port: the sparse-weight linear layer and the LM
stack (layers, attention, MoE, Mamba-2, the decoder stack, the Whisper-style
encoder-decoder, the frontend stubs and the model registry)."""
