"""The benchmark's inputs, made on the card from the seed: the synthetic
scene rendered through a distorted stereo rig (``render``), the closed
circuits flown over it and the flight-log priors (``circuit``)."""
