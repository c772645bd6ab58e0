"""Core of the port: policies, LIF dynamics, events, specs, quantisation
and the layer-program executor (counterparts of ``repro.core``)."""
