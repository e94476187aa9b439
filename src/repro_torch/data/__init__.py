"""Host-side numpy data pipelines."""
