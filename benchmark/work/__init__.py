"""The operations and bytes of each roofline class, from the model's shapes."""
