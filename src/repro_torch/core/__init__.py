"""Carbon model, scheduling and MARL client selection of the port."""
