"""The DA-STDK interpolation network."""
