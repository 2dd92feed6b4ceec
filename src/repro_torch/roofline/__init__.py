"""Roofline model of the port on the card (`analysis`)."""
