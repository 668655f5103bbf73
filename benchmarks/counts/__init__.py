"""Work counted from shapes: floating-point operations and bytes, and the
published peaks they are divided by."""
