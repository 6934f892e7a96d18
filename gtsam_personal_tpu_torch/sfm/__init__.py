"""Bundle adjustment: data, layout and the LM engine (torch)."""
