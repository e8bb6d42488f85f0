"""Task IR, pass pipeline, late scheduling, lowering and the op layer."""
