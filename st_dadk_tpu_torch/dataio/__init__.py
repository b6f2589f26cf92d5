"""Data ingest, the stand-in field, observation design and point buffers."""
