"""The plain reference: the published LLaMA-family training step in plain PyTorch.

fp32 throughout with TF32 off (or, as the precision control, fp8 products),
no kernels, no batching tricks. It imports nothing of the port: it takes the
benchmark's documents, tokenizer and seeded weights, and works out the packed
rows, the loss, the gradients and AdamW again itself.
"""
