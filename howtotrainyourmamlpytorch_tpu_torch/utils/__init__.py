"""Device choice, parameter trees and the config reader."""
