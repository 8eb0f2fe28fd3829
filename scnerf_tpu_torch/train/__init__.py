"""The NeRF train step: curriculum, optimizer chain, batch sampling on the device."""
