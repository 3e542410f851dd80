"""The language-model stack in PyTorch (the port's ``repro.models``):
config, parameter schema, layers, attention, the RG-LRU block, model
assembly and the serving steps."""
