"""Distribution and fault tolerance (the straggler monitor so far)."""
