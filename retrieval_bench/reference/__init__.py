"""The plain references the benchmark judges the port against. Nothing
here imports the port."""
