"""Image-pair selection and correspondence providers for the PRD loss."""
