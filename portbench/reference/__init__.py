"""Plain PyTorch references of the benchmark's configurations (float32,
TF32 off), the inputs made from a seed, and the control's rounding. This
package imports nothing of the measured program."""
