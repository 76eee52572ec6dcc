"""Networks: configuration DSL, layers and the ComputationGraph container."""
