"""The map as a struct of tensors, and its observer bitmap."""
