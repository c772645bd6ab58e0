"""DVS event ingestion (counterpart of ``repro.data``)."""
