"""The orbit-camera measure harness and its Measure.txt reader."""
