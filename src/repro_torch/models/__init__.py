"""The LM substrate's model code (counterpart of ``repro.models``): the
configuration, the elementary layers, attention, the RG-LRU block and the
decoder stack's forward, prefill and decode step."""
