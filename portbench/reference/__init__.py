"""The float32 plain-PyTorch reference of the served models and its
layout adapter; nothing here imports the port."""
