"""Host-side (numpy) schedule math for the flow-matching samplers."""
