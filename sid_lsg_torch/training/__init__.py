"""SiD-LSG distillation of the port: state and optimizer, LoRA, the train
step and the training loop."""
