"""The benchmark's plain reference (`lego/`), held apart from the port."""
