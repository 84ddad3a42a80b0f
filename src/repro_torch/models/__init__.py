"""The LM of the dense family (``lm``) and its layers (``layers``)."""
